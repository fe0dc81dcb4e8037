"""The CUDA decode-attention kernel (``csrc/decode_attention.cu``) and its
binding.

``csrc/decode_attention.cu`` replaces the TPU kernel
``src/repro/kernels/decode_attention/decode_attention.py:_decode_kernel``
as split-T flash-decoding: :func:`plan_decode_splits` cuts T into
``n_splits`` chunks; in one block per (chunk, kv head, batch) a producer
warp streams the chunk with TMA bulk copies through a ring of tiles of
:data:`KEY_TILE` keys and 8 consumer warps keep (acc, m, l) in f32 for the
group's heads; a second kernel merges the chunks in a fixed order.  The
tail of T is masked, so nothing is padded; with ``lengths`` each row's keys
past its length are masked too, and a split wholly past it loads nothing.
The plan reads neither the batch size nor the lengths, so a sequence's bits
do not depend on the batch it shares a launch with.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import cdiv, launch, ptr, stream_of

#: Dk and Dv: any size up to this
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)
#: keys per stage of the kernel's ring; every split is a multiple of it
KEY_TILE = 32
#: the fewest keys a split takes: its f32 partial (Dv + 2 floats per head)
#: then stays at most an eighth of the bf16 cache it reads at D = 128
MIN_KEYS_PER_SPLIT = 64
#: the grid the plan aims at, in blocks per SM
BLOCKS_PER_SM = 2
#: the batch the plan sizes its grid for (the LM path's decode batch).  The
#: plan must not read B; aiming one sequence alone at the card instead cut
#: T = 32768 into 128 splits of 256 keys, and at B = 4 the 1024 blocks and
#: the combine over 128 partials ran 1.6x slower than 32 splits of 1024 on
#: an H100 80GB HBM3 at 700 W (PERF.md §6)
PLAN_BATCH = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 11 + [_I] * 6 + [_P, ctypes.c_float, _I, _I, _I, _I, _I, _P]
_SYMBOL = {torch.float32: "repro_decode_attention_f32",
           torch.bfloat16: "repro_decode_attention_bf16"}


def plan_decode_splits(kvh: int, t: int, sm_count: int) -> Tuple[int, int]:
    """``(n_splits, keys_per_split)`` for a cache of ``t`` keys per kv head,
    ``kvh`` kv heads, on a card of ``sm_count`` SMs.

    ``keys_per_split`` is a multiple of :data:`KEY_TILE` and the splits
    cover ``[0, t)`` with none empty.  The plan takes no batch size, so a
    sequence's f32 sums over T are cut alike whatever batch it shares a
    launch with, and a row of a batched call has the bits of the same row
    called alone.  It aims the grid of a batch of :data:`PLAN_BATCH`
    sequences, ``n_splits * kvh * PLAN_BATCH`` blocks, at
    :data:`BLOCKS_PER_SM` blocks per SM, as far as the floor of
    :data:`MIN_KEYS_PER_SPLIT` keys per split allows (a small ``t`` gives
    one split).
    """
    if min(kvh, t, sm_count) < 1:
        raise ValueError(f"plan_decode_splits needs positive sizes, got "
                         f"kvh={kvh}, t={t}, sm_count={sm_count}")
    tiles = cdiv(t, KEY_TILE)
    want = cdiv(BLOCKS_PER_SM * sm_count, kvh * PLAN_BATCH)
    n = max(1, min(want, t // MIN_KEYS_PER_SPLIT, tiles))
    keys = cdiv(tiles, n) * KEY_TILE
    return cdiv(t, keys), keys


def launch_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, m: Optional[torch.Tensor],
                            l: Optional[torch.Tensor], *, scale: float,
                            partial: bool,
                            lengths: Optional[torch.Tensor] = None) -> None:
    """Launch on CUDA tensors of one dtype, q (B,H,Dk), k (B,KVH,T,Dk), v
    (B,KVH,T,Dv), each with a contiguous last axis, into the contiguous
    ``out`` (B,H,Dv) (q's dtype or f32; f32 when ``partial``) and f32
    ``m``, ``l`` (B,H,1) or None, on the current stream: the split kernel,
    then, when the plan gives more than one split, the combine kernel, over
    f32 scratch allocated here.  ``lengths``, a contiguous (B,) int64 CUDA
    tensor or None, limits row b to keys ``[0, lengths[b])`` and gives the
    model's weights (from each row's global max, found by a first kernel
    into f32 scratch, and rounded to the cache dtype before ``p @ v``); the
    plan does not read it.  Counts one launch."""
    b, h, dk = q.shape
    kvh, t, dv = k.shape[1], k.shape[2], v.shape[3]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_splits, kps = plan_decode_splits(kvh, t, sms)
    acc_s = m_s = l_s = mx_s = None
    if lengths is not None:
        mx_s = torch.empty((n_splits, b, h), dtype=torch.float32,
                           device=q.device)
    if n_splits > 1:
        acc_s = torch.empty((n_splits, b, h, dv), dtype=torch.float32,
                            device=q.device)
        m_s = torch.empty((n_splits, b, h), dtype=torch.float32, device=q.device)
        l_s = torch.empty_like(m_s)
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *k.stride()[:3],
                                      *v.stride()[:3])
    out_f32 = not partial and out.dtype == torch.float32
    launch("decode_attention", _SYMBOL[q.dtype], _ARGS, ptr(q), ptr(k), ptr(v),
           ptr(out), ptr(m), ptr(l), ptr(acc_s), ptr(m_s), ptr(l_s),
           ptr(lengths), ptr(mx_s), b, h, kvh, t, dk, dv,
           ctypes.cast(strides, _P),
           float(scale), int(partial), int(out_f32), n_splits, kps,
           q.device.index, stream_of(q))


_MAX_ARGS = [_P] * 5 + [_I] * 5 + [_P, ctypes.c_float, _I, _I, _I, _P]
_MAX_SYMBOL = {torch.float32: "repro_decode_max_f32",
               torch.bfloat16: "repro_decode_max_bf16"}
_PART_ARGS = [_P] * 11 + [_I] * 6 + [_P, ctypes.c_float, _I, _I, _I, _P]
_PART_SYMBOL = {torch.float32: "repro_decode_partial_f32",
                torch.bfloat16: "repro_decode_partial_bf16"}


def launch_decode_max(q: torch.Tensor, k: torch.Tensor,
                      lengths: torch.Tensor, m: torch.Tensor, *,
                      scale: float) -> None:
    """The T-sharded step's max pass over one shard's keys: q (B,H,Dk) and
    k (B,KVH,T,Dk) CUDA tensors of one dtype with a contiguous last axis,
    ``lengths`` a contiguous (B,) int64 CUDA tensor (0 allowed), into the
    contiguous f32 ``m`` (B,H): ``decode_max_kernel`` over the plan's
    splits, then one kernel that takes each row's max over them.  Counts
    one launch of ``decode_attention``."""
    b, h, dk = q.shape
    kvh, t = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_splits, kps = plan_decode_splits(kvh, t, sms)
    mx_s = torch.empty((n_splits, b, h), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 5)(*q.stride()[:2], *k.stride()[:3])
    launch("decode_attention", _MAX_SYMBOL[q.dtype], _MAX_ARGS, ptr(q),
           ptr(k), ptr(lengths), ptr(mx_s), ptr(m), b, h, kvh, t, dk,
           ctypes.cast(strides, _P), float(scale), n_splits, kps,
           q.device.index, stream_of(q))


def launch_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, gmax: torch.Tensor,
                          acc: torch.Tensor, l: torch.Tensor, *,
                          scale: float) -> None:
    """The T-sharded step's partial pass over one shard's keys, given each
    row's global max ``gmax`` (contiguous f32 (B,H)): the split kernel (and
    the combine kernel over the plan's splits, in order) with that max
    fixed, into the contiguous f32 ``acc`` (B,H,Dv) and ``l`` (B,H).
    Tensors as :func:`launch_decode_attention` takes them.  Counts one
    launch of ``decode_attention``."""
    b, h, dk = q.shape
    kvh, t, dv = k.shape[1], k.shape[2], v.shape[3]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_splits, kps = plan_decode_splits(kvh, t, sms)
    acc_s = m_s = l_s = None
    if n_splits > 1:
        acc_s = torch.empty((n_splits, b, h, dv), dtype=torch.float32,
                            device=q.device)
        m_s = torch.empty((n_splits, b, h), dtype=torch.float32,
                          device=q.device)
        l_s = torch.empty_like(m_s)
    m_out = torch.empty_like(l)
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *k.stride()[:3],
                                      *v.stride()[:3])
    launch("decode_attention", _PART_SYMBOL[q.dtype], _PART_ARGS, ptr(q),
           ptr(k), ptr(v), ptr(acc), ptr(m_out), ptr(l), ptr(acc_s),
           ptr(m_s), ptr(l_s), ptr(lengths), ptr(gmax), b, h, kvh, t, dk, dv,
           ctypes.cast(strides, _P), float(scale), n_splits, kps,
           q.device.index, stream_of(q))
