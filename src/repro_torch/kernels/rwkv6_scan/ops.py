"""Dispatching wrapper for the RWKV-6 WKV kernel.

``rwkv6_scan(r, k, v, w, u, state0)`` launches ``csrc/rwkv6_scan.cu``
(which replaces the TPU kernel
``src/repro/kernels/rwkv6_scan/rwkv6_scan.py:_rwkv6_kernel`` with a
chunked kernel on a cluster per head, latency- rather than FFMA-bound on
the H100; ``rwkv6_scan.py`` says how) on CUDA tensors, with or without
``state0``, and runs
:func:`~repro_torch.kernels.rwkv6_scan.ref.rwkv6_scan_plain` (the JAX
package's XLA chunked path) on CPU and ``meta`` tensors.  The JAX package
registers no Tiny-OpenCL family for it, so neither does the port.
"""

from __future__ import annotations

import torch

from ..common import on_card
from .ref import counts, rwkv6_scan_plain, rwkv6_scan_ref, rwkv6_step_ref
from .rwkv6_scan import COMPILED_D, DTYPES, launch_rwkv6_scan

__all__ = ["rwkv6_scan", "counts", "rwkv6_scan_ref", "rwkv6_step_ref"]


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state0: torch.Tensor | None = None, *, chunk: int = 32):
    """RWKV-6 WKV over a sequence: r/k/v/w (B,H,T,D), u (H,D), optional
    ``state0`` (B,H,D,D) (zeros when None: the same function).

    Returns (y (B,H,T,D) in r's dtype, final state (B,H,D,D) f32).
    ``chunk`` is the plain version's chunk; the kernel's is 32.  On the
    card r, k and v share a dtype, float32 with a float32
    w or bfloat16 with a float32 or bfloat16 w; D is 32 or 64; each of
    r, k, v, w may be a strided view whose last axis is contiguous.
    """
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError("rwkv6_scan takes r/k/v/w (B,H,T,D) and u (H,D)")
    b, h, t, d = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or tuple(u.shape) != (h, d)
            or (state0 is not None and tuple(state0.shape) != (b, h, d, d))):
        raise ValueError(
            f"rwkv6_scan shapes do not fit: r {tuple(r.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}, u "
            f"{tuple(u.shape)}, state0 "
            f"{None if state0 is None else tuple(state0.shape)}")
    tensors = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if not on_card(*tensors):
        return rwkv6_scan_plain(r, k, v, w, u, state0, chunk=chunk)
    if (k.dtype != r.dtype or v.dtype != r.dtype
            or (r.dtype, w.dtype) not in DTYPES):
        raise TypeError(
            f"the rwkv6_scan kernel takes r/k/v of one dtype with w as in "
            f"{[(str(a), str(b_)) for a, b_ in DTYPES]}; got r {r.dtype}, k "
            f"{k.dtype}, v {v.dtype}, w {w.dtype}")
    if d not in COMPILED_D:
        raise ValueError(f"the rwkv6_scan kernel is compiled for D in "
                         f"{COMPILED_D}; got D={d}")
    if any(x.stride(-1) != 1 for x in (r, k, v, w)):
        raise ValueError("rwkv6_scan: the kernel takes a contiguous last axis")
    # u and state0 are read as contiguous f32, as the JAX op casts them
    u = u.to(torch.float32).contiguous()
    if state0 is not None:
        state0 = state0.to(torch.float32).contiguous()
    y = torch.empty((b, h, t, d), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if b * h:
        launch_rwkv6_scan(r, k, v, w, u, state0, y, state)
    return y, state
