"""Dispatching wrapper for the RWKV-6 WKV kernel.

``rwkv6_scan(r, k, v, w, u, state0)`` launches ``csrc/rwkv6_scan.cu``
(which replaces the TPU kernel
``src/repro/kernels/rwkv6_scan/rwkv6_scan.py:_rwkv6_kernel`` with a
chunked kernel on a cluster per head, latency- rather than FFMA-bound on
the H100; ``rwkv6_scan.py`` says how) on CUDA tensors, with or without
``state0``, and runs
:func:`~repro_torch.kernels.rwkv6_scan.ref.rwkv6_scan_plain` (the JAX
package's XLA chunked path) on CPU and ``meta`` tensors.  It is
differentiable on both: on the card, when an input requires grad, through
:class:`_RWKV6Scan`, whose forward launches the same kernel and whose
backward launches ``csrc/rwkv6_scan_bwd.cu`` (:func:`rwkv6_scan_bwd`); on
the CPU autograd runs through the plain version.  The JAX package
registers no Tiny-OpenCL family for it, so neither does the port.
"""

from __future__ import annotations

import torch

from ..common import on_card
from .ref import (counts, rwkv6_scan_bwd_plain, rwkv6_scan_plain,
                  rwkv6_scan_ref, rwkv6_step_ref)
from .rwkv6_scan import (COMPILED_D, DTYPES, launch_rwkv6_scan,
                         launch_rwkv6_scan_bwd)

__all__ = ["rwkv6_scan", "rwkv6_scan_bwd", "counts", "rwkv6_scan_ref",
           "rwkv6_step_ref"]


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
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        if state0 is not None:
            raise NotImplementedError(
                "the rwkv6_scan backward kernel takes no state0 (the train "
                "path starts from zeros); got a state0 under autograd")
        return _RWKV6Scan.apply(r, k, v, w, u)
    return _card_forward(r, k, v, w, u, state0)


def _card_forward(r, k, v, w, u, state0):
    """(y, final state): one launch of the forward kernel."""
    b, h, t, d = r.shape
    # u and state0 are read as contiguous f32, as the JAX op casts them
    u = u.to(torch.float32).contiguous()
    if state0 is not None:
        state0 = state0.to(torch.float32).contiguous()
    y = torch.empty((b, h, t, d), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if b * h:
        launch_rwkv6_scan(r, k, v, w, u, state0, y, state)
    return y, state


class _RWKV6Scan(torch.autograd.Function):
    """The card's differentiable scan from a zero state: the forward
    kernel, and the backward kernel for (r, k, v, w, u).  The final state
    takes no gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, state = _card_forward(r, k, v, w, u, None)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        r, k, v, w, u = ctx.saved_tensors
        dr, dk, dv, dw, du = rwkv6_scan_bwd(r, k, v, w, u, dy)
        return dr, dk, dv, dw.to(w.dtype), du.to(u.dtype)


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """(dr, dk, dv, dw, du) of ``rwkv6_scan(r, k, v, w, u)`` (no state in,
    no gradient into the final state) for the output's gradient ``dy``: dr,
    dk, dv in r's dtype, dw (B,H,T,D) and du (H,D) in f32.

    On CUDA tensors it launches ``csrc/rwkv6_scan_bwd.cu`` (dtypes and D as
    the forward kernel takes them; views are copied contiguous first); on
    CPU and ``meta`` tensors it runs the plain version, autograd through
    :func:`rwkv6_scan_plain`."""
    if not on_card(r, k, v, w, u, dy):
        return rwkv6_scan_bwd_plain(r, k, v, w, u, dy)
    if (k.dtype != r.dtype or v.dtype != r.dtype
            or (r.dtype, w.dtype) not in DTYPES):
        raise TypeError(
            f"the rwkv6_scan backward kernel takes r/k/v of one dtype with w "
            f"as in {[(str(a), str(b_)) for a, b_ in DTYPES]}; got r "
            f"{r.dtype}, k {k.dtype}, v {v.dtype}, w {w.dtype}")
    b, h, t, d = r.shape
    if d not in COMPILED_D:
        raise ValueError(f"the rwkv6_scan backward kernel is compiled for D "
                         f"in {COMPILED_D}; got D={d}")
    r, k, v, w = (x.contiguous() for x in (r, k, v, w))
    dy = dy.to(r.dtype).contiguous()
    u = u.to(torch.float32).contiguous()
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.zeros((h, d), dtype=torch.float32, device=r.device)
    if not (b * h * t):
        return dr.zero_(), dk.zero_(), dv.zero_(), dw.zero_(), du
    launch_rwkv6_scan_bwd(r, k, v, w, u, dy, dr, dk, dv, dw, du)
    return dr, dk, dv, dw, du
