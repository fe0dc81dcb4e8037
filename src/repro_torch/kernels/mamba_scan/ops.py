"""Dispatching wrapper for the Mamba selective-scan kernel + TinyCL
registration.

``mamba_scan(x, delta, a, b, c, d, state0)`` launches ``csrc/mamba_scan.cu``
(which replaces the TPU kernel
``src/repro/kernels/mamba_scan/mamba_scan.py:_mamba_kernel``) on CUDA
tensors, with or without ``state0``, and runs :func:`~repro_torch.kernels.
mamba_scan.ref.mamba_scan_plain` (the JAX package's XLA chunked path) on
CPU and ``meta`` tensors; on every device the wrapper then adds the
``D * x`` skip term as the JAX op does (``ops.py:86-88``).  The scan is
differentiable on both: on the card, when an input requires grad, through
:class:`_SelectiveScan`, whose forward launches the same kernel and whose
backward launches ``csrc/mamba_scan_bwd.cu`` (:func:`mamba_scan_bwd`); on
the CPU autograd runs through the plain version.  The skip term's gradient
is PyTorch's, outside the kernels.
"""

from __future__ import annotations

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_contiguous, on_card
from .mamba_scan import (COMPILED_N, DTYPES, launch_mamba_scan,
                         launch_mamba_scan_bwd)
from .ref import (counts, mamba_scan_bwd_plain, mamba_scan_plain,
                  mamba_scan_ref, mamba_step_ref)

__all__ = ["mamba_scan", "selective_scan", "mamba_scan_bwd", "counts",
           "mamba_scan_ref", "mamba_step_ref", "build_kernel"]


def selective_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   state0: torch.Tensor | None = None, *, chunk: int = 64):
    """The scan the kernel computes: (y (B,T,Dm) in x's dtype WITHOUT the
    skip term, final state (B,Dm,N) f32).  Shapes as :func:`mamba_scan`."""
    tensors = (x, delta, a, b, c) + (() if state0 is None else (state0,))
    if not on_card(*tensors):
        return mamba_scan_plain(x, delta, a, b, c, state0, chunk=chunk)
    if (x.dtype, delta.dtype) not in DTYPES:
        raise TypeError(
            f"the mamba_scan kernel takes (x, delta) dtypes in "
            f"{[(str(p), str(q)) for p, q in DTYPES]}; got {x.dtype}, "
            f"{delta.dtype}")
    if a.shape[1] not in COMPILED_N:
        raise ValueError(f"the mamba_scan kernel is compiled for N in "
                         f"{COMPILED_N}; got N={a.shape[1]}")
    check_contiguous("mamba_scan", x, delta)
    if torch.is_grad_enabled() and any(z.requires_grad for z in tensors):
        if state0 is not None:
            raise NotImplementedError(
                "the mamba_scan backward kernel takes no state0 (the train "
                "path starts from zeros); got a state0 under autograd")
        return _SelectiveScan.apply(x, delta, a, b, c)
    return _card_forward(x, delta, a, b, c, state0)


def _card_forward(x, delta, a, b, c, state0):
    """(y without the skip, final state): one launch of the forward
    kernel."""
    # a, b, c and state0 are read as contiguous f32, as the JAX op casts them
    a, b, c = (z.to(torch.float32).contiguous() for z in (a, b, c))
    if state0 is not None:
        state0 = state0.to(torch.float32).contiguous()
    bsz, t, dm = x.shape
    y = torch.empty_like(x)
    state = torch.empty((bsz, dm, a.shape[1]), dtype=torch.float32,
                        device=x.device)
    if bsz * dm:
        launch_mamba_scan(x, delta, a, b, c, state0, y, state)
    return y, state


class _SelectiveScan(torch.autograd.Function):
    """The card's differentiable scan from a zero state: the forward kernel,
    and the backward kernel for (x, delta, a, b, c).  The final state takes
    no gradient."""

    @staticmethod
    def forward(ctx, x, delta, a, b, c):
        y, state = _card_forward(x, delta, a, b, c, None)
        ctx.save_for_backward(x, delta, a, b, c)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        x, delta, a, b, c = ctx.saved_tensors
        dx, ddelta, da, db, dc = mamba_scan_bwd(x, delta, a, b, c, dy)
        return dx, ddelta, da.to(a.dtype), db.to(b.dtype), dc.to(c.dtype)


def mamba_scan_bwd(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor):
    """(dx, ddelta, da, db, dc) of ``selective_scan(x, delta, a, b, c)``
    (no state in, no gradient into the final state) for the output's
    gradient ``dy``: dx in x's dtype, ddelta in delta's, da (Dm,N), db and
    dc (B,T,N) in f32.

    On CUDA tensors it launches ``csrc/mamba_scan_bwd.cu`` (dtypes and N as
    the forward kernel takes them; views are copied contiguous first); on
    CPU and ``meta`` tensors it runs the plain version, autograd through
    :func:`mamba_scan_plain`."""
    if not on_card(x, delta, a, b, c, dy):
        return mamba_scan_bwd_plain(x, delta, a, b, c, dy)
    if (x.dtype, delta.dtype) not in DTYPES:
        raise TypeError(
            f"the mamba_scan backward kernel takes (x, delta) dtypes in "
            f"{[(str(p), str(q)) for p, q in DTYPES]}; got {x.dtype}, "
            f"{delta.dtype}")
    bsz, t, dm = x.shape
    n = a.shape[1]
    if n not in COMPILED_N:
        raise ValueError(f"the mamba_scan backward kernel is compiled for N "
                         f"in {COMPILED_N}; got N={n}")
    f32 = torch.float32
    x, delta = x.contiguous(), delta.contiguous()
    dy = dy.to(x.dtype).contiguous()
    a, b, c = (z.to(f32).contiguous() for z in (a, b, c))
    dx, ddelta = torch.empty_like(x), torch.empty_like(delta)
    da = torch.zeros((dm, n), dtype=f32, device=x.device)
    db, dc = (torch.zeros((bsz, t, n), dtype=f32, device=x.device)
              for _ in range(2))
    if not (bsz * t * dm):
        return dx.zero_(), ddelta.zero_(), da, db, dc
    launch_mamba_scan_bwd(x, delta, a, b, c, dy, dx, ddelta, da, db, dc)
    return dx, ddelta, da, db, dc


def mamba_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
               state0: torch.Tensor | None = None, *, chunk: int = 64):
    """Selective scan: x/delta (B,T,Dm), a (Dm,N), b/c (B,T,N), d (Dm,),
    optional ``state0`` (B,Dm,N) (zeros when None: the same function).

    Returns (y (B,T,Dm) in x's dtype, including the D*x skip, final state
    (B,Dm,N) f32).  ``chunk`` is the plain version's chunk; the kernel walks
    the steps one by one.  On the card x and delta are float32, or x
    bfloat16 with a float32 or bfloat16 delta, both contiguous, and N is one
    of 2, 4, 8, 16, 32.
    """
    if x.dim() != 3 or a.dim() != 2 or d.dim() != 1:
        raise ValueError("mamba_scan takes x/delta (B,T,Dm), a (Dm,N), "
                         "b/c (B,T,N), d (Dm,)")
    bsz, t, dm = x.shape
    n = a.shape[1]
    if (delta.shape != x.shape or a.shape[0] != dm
            or tuple(b.shape) != (bsz, t, n) or tuple(c.shape) != (bsz, t, n)
            or d.shape[0] != dm
            or (state0 is not None and tuple(state0.shape) != (bsz, dm, n))):
        raise ValueError(
            f"mamba_scan shapes do not fit: x {tuple(x.shape)}, delta "
            f"{tuple(delta.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"c {tuple(c.shape)}, d {tuple(d.shape)}")
    y, h = selective_scan(x, delta, a, b, c, state0, chunk=chunk)
    y = y + (x.float() * d[None, None].float()).to(y.dtype)
    return y, h


@kernel_family("mamba_scan")
def build_kernel(config: EGPUConfig = EGPU_16T, *, chunk: int = 64) -> Kernel:
    """TinyCL kernel object: selective scan x/delta (B,T,Dm), a (Dm,N),
    b/c (B,T,N), d (Dm,) -> (y, final_state)."""
    return Kernel(
        name="mamba_scan",
        executor=(lambda x, delta, a, b, c, d:
                  mamba_scan(x, delta, a, b, c, d, chunk=chunk)),
        counts=lambda bsz, t, dm, n, itemsize=4: counts(bsz, t, dm, n,
                                                        itemsize),
    )
