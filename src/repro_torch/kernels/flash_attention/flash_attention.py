"""The CUDA flash-attention kernel (``csrc/flash_attention.cu``) and its
binding.

``csrc/flash_attention.cu`` replaces the TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py:_flash_kernel``.
One block per (batch, head, tile of 64 q rows) runs the whole kv loop
itself, streaming kv tiles through shared memory with the online softmax
state in f32 registers; the kv head is read in place (GQA), causal tiles
above the diagonal are skipped and the ragged tails are masked in the
kernel, so nothing is padded.  bfloat16 at the head dims of
``MMA_HEAD_DIMS`` runs ``flash_wgmma_kernel``: blocks of 128 q rows, K and V
tiles brought by TMA through a shared-memory ring, both products on
``wgmma``; it reads q, k and v through tensor maps, so each must be a view
that :func:`tma_describable` accepts, and the wrapper copies one that is not
(counted in :data:`CONTIGUOUS_COPIES`).  float32 and the other head dims run
f32 FMAs on the CUDA cores.  Both kernels can also write each row's
log-sum-exp for the backward.

``csrc/flash_attention_bwd.cu`` is that kernel's gradient (dQ, dK, dV,
FlashAttention-2's deterministic two-kernel backward), for the (Dk, Dv)
pairs of :data:`BWD_PAIRS` (Dk = Dv in :data:`BWD_HEAD_DIMS`, and MLA's
(192, 128)), counted as ``flash_attention_bwd``.  bfloat16 runs its
tensor-core kernels (TMA, ``wgmma``; q, k, v and the output's gradient read
through tensor maps), float32 its CUDA-core kernels (:func:`bwd_route`).
Neither is a fallback of the other: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..common import launch, ptr, stream_of

#: (Dk, Dv) pairs the tensor-core (bf16) kernel, flash_wgmma_kernel, is
#: compiled for: hubert's (80, 80), MLA's (192, 128) and paligemma's (256,
#: 256) among them
MMA_HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (96, 96), (128, 128),
                 (96, 64), (192, 128), (256, 256))
#: Dv values csrc/flash_attention.cu is compiled for (each thread's output
#: strip of the CUDA-core kernel is Dv / 16 registers wide): 80 is hubert's
#: head dim (bf16 (80, 80) on the tensor cores), 256 paligemma's
COMPILED_DV = (32, 64, 80, 96, 128, 256)
#: Dk: any multiple of 4 up to this (a loop bound; Qs and Ks grow with it)
MAX_DK = 256
DTYPES = (torch.float32, torch.bfloat16)

#: bf16 views that no tensor map describes, made contiguous before a launch
#: of the tensor-core kernel (a copy, then the same kernel) in this process
CONTIGUOUS_COPIES = 0

#: head dims (Dk = Dv) csrc/flash_attention_bwd.cu is compiled for: 256 is
#: paligemma's
BWD_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
#: of those, the bfloat16 head dims its tensor-core kernels
#: (``flash_dq_wgmma_kernel``, ``flash_dkdv_wgmma_kernel``) take: all of
#: them (at 80 the products that accumulate 80 columns run 96 wide over
#: zero-filled columns)
BWD_MMA_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
#: (Dk, Dv) pairs with Dk != Dv it is compiled for: MLA's (deepseek-v2's
#: nope 128 + rope 64 against v 128), float32 on the CUDA cores and bfloat16
#: on the tensor cores
BWD_MLA_PAIRS = ((192, 128),)
#: every (Dk, Dv) pair the backward takes, and those bfloat16 takes on the
#: tensor cores
BWD_PAIRS = tuple((d, d) for d in BWD_HEAD_DIMS) + BWD_MLA_PAIRS
BWD_MMA_PAIRS = tuple((d, d) for d in BWD_MMA_HEAD_DIMS) + BWD_MLA_PAIRS

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float,
         _I, _I, _I, _I, _I, _P]
_SYMBOL = {torch.float32: "repro_flash_attention_f32",
           torch.bfloat16: "repro_flash_attention_bf16"}
_BWD_ARGS = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _I, _I, _P, _I, _P]
_BWD_SYMBOL = {torch.float32: "repro_flash_attention_bwd_f32",
               torch.bfloat16: "repro_flash_attention_bwd_bf16"}


def supports_head_dims(dk: int, dv: int) -> bool:
    return 0 < dk <= MAX_DK and dk % 4 == 0 and dv in COMPILED_DV


def tma_describable(data_ptr: int, sizes: Sequence[int],
                    strides: Sequence[int], itemsize: int) -> bool:
    """Whether a tensor map (``cuTensorMapEncodeTiled``) describes the view:
    a 16-byte-aligned base, a contiguous last axis of a whole number of 16
    bytes, and every other axis of more than one element a positive stride
    that is a multiple of 16 bytes and below 2**40 bytes."""
    if data_ptr % 16 or strides[-1] != 1 or (sizes[-1] * itemsize) % 16:
        return False
    return all(size <= 1 or (st > 0 and (st * itemsize) % 16 == 0
                             and st * itemsize < 2 ** 40)
               for size, st in zip(sizes[:-1], strides[:-1]))


def tma_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when a tensor map describes it, else a contiguous copy
    (counted in :data:`CONTIGUOUS_COPIES`)."""
    global CONTIGUOUS_COPIES
    if tma_describable(x.data_ptr(), x.shape, x.stride(), x.element_size()):
        return x
    CONTIGUOUS_COPIES += 1
    return x.contiguous()


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, *, causal: bool, scale: float,
                           q_offset: int, bq: int, bk: int,
                           lse: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel on CUDA tensors of one dtype, q (B,H,S,Dk), k
    (B,KVH,T,Dk), v (B,KVH,T,Dv), each with a contiguous last axis, into the
    contiguous ``out`` (B,H,S,Dv), on the current stream.  ``bq`` and ``bk``
    are the plain version's blocks: with ``q_offset < 0`` they decide what a
    row that sees no key gets, and a final pass writes those rows.  A
    contiguous f32 ``lse`` (B,H,S) receives each row's log-sum-exp (natural
    log) for the backward; ``out``'s bits are the same without it."""
    b, h, s, dk = q.shape
    kvh, t, dv = k.shape[1], k.shape[2], v.shape[3]
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    launch("flash_attention", _SYMBOL[q.dtype], _ARGS, ptr(q), ptr(k), ptr(v),
           ptr(out), ptr(lse), b, h, kvh, s, t, dk, dv,
           ctypes.cast(strides, _P), float(scale), int(causal), int(q_offset),
           int(bq), int(bk), q.device.index, stream_of(q))


def bwd_route(dtype: torch.dtype, dk: int, dv: Optional[int] = None) -> str:
    """Which kernels of ``csrc/flash_attention_bwd.cu`` compute the
    gradient at (Dk, Dv) = (``dk``, ``dv``) (``dv`` None: Dk = Dv):
    ``"wgmma"`` (the tensor cores) for bfloat16 at :data:`BWD_MMA_PAIRS`,
    ``"cuda_cores"`` for float32 and any pair of :data:`BWD_PAIRS` outside
    them (none now).
    Raises ``ValueError`` for a pair neither takes."""
    pair = (dk, dk if dv is None else dv)
    if pair not in BWD_PAIRS:
        raise ValueError(f"the flash-attention backward kernels take Dk = Dv "
                         f"in {BWD_HEAD_DIMS} and the (Dk, Dv) pairs "
                         f"{BWD_MLA_PAIRS}; got {pair}")
    if dtype == torch.bfloat16 and pair in BWD_MMA_PAIRS:
        return "wgmma"
    return "cuda_cores"


def launch_flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, dout: torch.Tensor,
                               lse: torch.Tensor, delta: torch.Tensor,
                               dq: torch.Tensor, dk: torch.Tensor,
                               dv: torch.Tensor, *, causal: bool,
                               scale: float, q_offset: int = 0) -> None:
    """Launch ``csrc/flash_attention_bwd.cu`` (its two kernels of the route
    :func:`bwd_route` picks, one count) on contiguous CUDA tensors of one
    dtype: q, dq (B,H,S,Dk), dout (B,H,S,Dv), k, dk (B,KVH,T,Dk), v, dv
    (B,KVH,T,Dv), (Dk, Dv) in :data:`BWD_PAIRS`; ``lse`` the forward's f32
    (B,H,S) and ``delta`` f32 (B,H,S) scratch; ``q_offset >= 0`` the
    absolute position of q's first row (causal masking keeps
    ``q_offset + i >= j``).  On the tensor-core route q,
    k, v and dout must be 16-byte aligned (:func:`tma_view`), and a GQA
    group (H > KVH) takes one block a head for dK and dV, into f32 partials
    allocated here, which a third kernel adds in head order."""
    b, h, s, d_k = q.shape
    kvh, t, d_v = k.shape[1], k.shape[2], v.shape[3]
    wgmma = bwd_route(q.dtype, d_k, d_v) == "wgmma"
    part = (torch.empty((h * b * t * (d_k + d_v),), dtype=torch.float32,
                        device=q.device)
            if wgmma and h > kvh else None)
    launch("flash_attention_bwd", _BWD_SYMBOL[q.dtype], _BWD_ARGS, ptr(q),
           ptr(k), ptr(v), ptr(dout), ptr(lse), ptr(delta), ptr(dq), ptr(dk),
           ptr(dv), b, h, kvh, s, t, d_k, d_v, float(scale), int(causal),
           int(q_offset), int(wgmma), ptr(part), q.device.index, stream_of(q))
