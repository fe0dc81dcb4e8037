"""Plain PyTorch version + counts for the FIR filter (TinyBio stage 1).

The paper's pipeline filters the raw biosignal with a causal FIR filter.
The e-GPU runs integer/fixed-point arithmetic (no FPU, §IV-A), so there are
two paths: a Q15-style int32 fixed-point path (paper-faithful) and an fp32
path.  :func:`fir_ref` adds the taps in the JAX kernel's order, and the CUDA
kernel (``csrc/fir.cu``) repeats exactly this arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.machine import WorkCounts

FXP_SHIFT = 15  # Q1.15 coefficients
_LOW32 = 0xFFFFFFFF


def fir_ref(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR: y[n] = sum_t h[t] * x[n - t] (zero-padded history), along
    the last axis of ``x`` (a signal, or a stack of signals filtered each
    on its own).

    Float inputs accumulate in fp32, ``acc = acc + h[t] * x[n - t]`` for
    t = 0..taps-1, each product and sum rounded on its own.  Integer inputs
    multiply and accumulate with int32 wraparound (kept in the low 32 bits
    of int64 so no step overflows), shift right arithmetically by
    :data:`FXP_SHIFT` (Q15) and narrow back to ``x``'s dtype.
    """
    taps, n = h.shape[0], x.shape[-1]
    fixed = not x.dtype.is_floating_point
    work = torch.int64 if fixed else torch.float32
    xp = F.pad(x.to(work), (taps - 1, 0))
    hw = h.to(work)
    acc = torch.zeros(x.shape, dtype=work, device=x.device)
    for t in range(taps):
        prod = hw[t] * xp[..., taps - 1 - t: taps - 1 - t + n]
        acc = acc + (prod & _LOW32 if fixed else prod)
    if not fixed:
        return acc
    acc = acc & _LOW32
    acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)   # as int32
    return (acc >> FXP_SHIFT).to(x.dtype)


def counts(n: int, taps: int, itemsize: int = 4) -> WorkCounts:
    macs = float(n) * taps
    # each input sample is loaded from the D$ once (register sliding window);
    # outputs stream back
    dcache = 2.0 * n * itemsize
    host = 2.0 * n * itemsize            # raw signal in, filtered signal out
    # streaming kernel: the *live* working set is the tap window + the
    # current cache lines, not the whole signal (which is read once) — so
    # the D$-capacity traffic inflation must not trigger.
    return WorkCounts(ops=macs, dcache_bytes=dcache, host_bytes=host,
                      working_set=float(taps + 256) * itemsize)
