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

``csrc/rwkv6_scan_bwd.cu`` is the scan's gradient (no state in, no gradient
into the final state), which replaces no TPU kernel: the JAX package takes
it from ``jax.grad`` of its XLA path.  It is the forward's chunked form run
backwards, one block per (batch, head): a forward sweep of the chunked
state update keeps each chunk's starting state in shared memory (a scratch
buffer only where they do not fit, :func:`bwd_scratch_words`); then, chunk
by chunk from the last, the carry dL/dS, dv and the chunk's cross products
run on the tensor cores (TF32 in three parts) and dr, dk and dw come from
running recurrences a channel.  dw is taken from its definition (a sum of
G * S over the columns, expanded into products of decays), never from
differences of log w.  Inputs are read through their strides and the
gradients written through theirs, so the model's transposed views need no
copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import kernel_library, launch, ptr, stream_of

#: head dims the kernel is compiled for (clusters of D / 32 blocks)
COMPILED_D = (32, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P]
#: (dtype of r, k and v; dtype of w) -> entry point
_SYMBOL = {(torch.float32, torch.float32): "repro_rwkv6_scan_f32",
           (torch.bfloat16, torch.float32): "repro_rwkv6_scan_bf16",
           (torch.bfloat16, torch.bfloat16): "repro_rwkv6_scan_bf16w"}
DTYPES = tuple(_SYMBOL)
_BWD_ARGS = [_P] * 13 + [_I] * 4 + [_P, _I, _P]
_BWD_SYMBOL = {key: name.replace("scan", "scan_bwd")
               for key, name in _SYMBOL.items()}


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


def bwd_scratch_words(t: int, d: int, device: int) -> int:
    """f32 words of scratch the backward kernel needs a (batch, head) for
    its chunk states at this T and D on ``device``: 0 where they fit in
    shared memory (T <= 224 at D = 64)."""
    fn = kernel_library().repro_rwkv6_scan_bwd_scratch
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I]
        fn.restype = ctypes.c_longlong
    words = fn(t, d, device)
    if words < 0:
        raise RuntimeError(f"repro_rwkv6_scan_bwd_scratch failed for T={t}, "
                           f"D={d} on cuda:{device}")
    return words


def launch_rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                          dr: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                          dw: torch.Tensor, du: torch.Tensor) -> None:
    """Launch the backward on CUDA tensors r/k/v/w/dy (B,H,T,D), T >= 1,
    each with a contiguous last axis and any other strides, and the
    contiguous f32 ``u`` (H,D), into ``dr``, ``dk``, ``dv`` (r's dtype) and
    ``dw`` (B,H,T,D) f32, written through their own strides, and the
    contiguous ``du`` (H,D) f32, on the current stream.  The spilled chunk
    states (if any) and du's per-row partials are scratch allocated
    here."""
    b, h, t, d = r.shape
    dev = r.device
    words = bwd_scratch_words(t, d, dev.index)
    hist = (torch.empty(b * h * words, dtype=torch.float32, device=dev)
            if words else None)
    du_part = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 27)(*(s for x in (r, k, v, w, dy, dr, dk,
                                                     dv, dw)
                                         for s in x.stride()[:3]))
    launch("rwkv6_scan_bwd", _BWD_SYMBOL[r.dtype, w.dtype], _BWD_ARGS,
           ptr(r), ptr(k), ptr(v), ptr(w), ptr(u), ptr(dy), ptr(dr), ptr(dk),
           ptr(dv), ptr(dw), ptr(hist), ptr(du_part), ptr(du), b, h, t, d,
           ctypes.cast(strides, _P), dev.index, stream_of(r))
